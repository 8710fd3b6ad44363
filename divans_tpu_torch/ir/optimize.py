"""IR optimizer — the cost-model "actuary" pass (reference:
src/ir_optimize/mod.rs should_merge + statistics_tracking_codec.rs).

The reference replays commands through a shadow codec, summing -log2(p),
and greedily merges Literal+Copy into longer literals when the copy costs
more bits than literal-coding its bytes.  Our equivalent uses closed-form
cost estimates calibrated from the billing tool (codec/billing.py):

  copy cost   ~ cmd-type + length-mnemonic/mantissa + distance
               (distance-LRU hits are cheap, far distances ~1.4*log2(d))
  literal cost~ per-byte model cost estimated from the block's order-1
               conditional entropy (a good proxy for the context-mapped
               literal model), plus amortized length-header cost

Converting a marginal copy to literal bytes also *helps* neighbouring
literals (one merged run, one length header), which the estimates credit.

A copy of divans_tpu/ir/optimize.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

from . import commands as cmds


def order1_bits_per_byte(raw: bytes) -> float:
    """Order-1 conditional entropy of the block, bits/byte."""
    if len(raw) < 2:
        return 8.0
    a = np.frombuffer(raw, np.uint8)
    pairs = a[:-1].astype(np.int32) * 256 + a[1:]
    counts = np.bincount(pairs, minlength=65536).reshape(256, 256)
    row = counts.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = counts / np.maximum(row, 1)
        h = np.where(counts > 0, -counts * np.log2(np.maximum(p, 1e-12)), 0.0)
    return float(h.sum() / max(1, len(raw) - 1))


def _copy_cost_bits(num_bytes: int, distance: int, lru: list[int]) -> float:
    """Calibrated against billing output on the reference corpus: the
    adaptive distance model averages ~12 bits/copy on text (far below a
    log2(d) static estimate), so only clearly-degenerate copies lose."""
    cost = 1.6                                    # command-type nibble
    if num_bytes < 15:
        cost += 2.5                               # CountSmall mnemonic
    else:
        cost += 4.0 + 0.7 * ((num_bytes.bit_length() - 4) & ~3)
    if distance in lru:
        cost += 3.0                               # mnemonic hit
    else:
        cost += 4.0 + 0.55 * distance.bit_length()
    return cost


def optimize_measured(raw: bytes, commands: list[cmds.Command],
                      options, layout=None) -> list[cmds.Command]:
    """Measured-cost actuary (divans_ir_optimizer >= 2).

    The reference probes each merge candidate against a shadow codec
    (TallyingArithmeticEncoder).  Our two-pass structure gives the same
    information in one batch: trace the command stream, replay the model
    (chunk-deferred replay — within ~1% of the adaptive costs), and read
    off each command's *exact* coded bits.  A copy is demoted to literal
    bytes when its measured bits exceed the locally-measured literal
    rate times its length (plus the saved length-header bits when it
    merges into an adjacent literal).
    """
    import math

    from ..codec import deferred as deferred_mod
    from ..codec import trace as trace_mod
    from ..codec.layout import ModelLayout, PROFILES, profile_for_options

    if layout is None:
        layout = ModelLayout(PROFILES[profile_for_options(options)])
    try:
        tr, bounds = trace_mod.build_trace_with_bounds(
            raw, commands, options, layout)
    except (KeyError, AssertionError):
        return optimize(raw, commands)        # out of profile: heuristic
    if tr.shape[0] == 0:
        return commands
    _, freqs = deferred_mod.replay_trace(tr, 256)
    bits = -np.log2(np.maximum(freqs, 1) / 32768.0)

    # measured literal content rate (bits/byte), global + per-command
    is_lit_row = tr[:, 2] == 1
    cmd_cost = [float(bits[a:b].sum()) for a, b in bounds]
    lit_rates = []
    for (a, b), c in zip(bounds, commands):
        if isinstance(c, cmds.Literal) and len(c.data) >= 8:
            content = bits[a:b][is_lit_row[a:b]].sum()
            lit_rates.append((a, content / len(c.data)))
    if not lit_rates:
        return commands
    global_rate = float(np.mean([r for _, r in lit_rates]))

    def local_rate(row):
        best, bd = global_rate, 1 << 30
        for a, r in lit_rates:
            d = abs(a - row)
            if d < bd:
                bd, best = d, r
        return 0.5 * (best + global_rate)

    out: list[cmds.Command] = []
    pos = 0
    for i, ((a, b), c) in enumerate(zip(bounds, commands)):
        if isinstance(c, cmds.Copy):
            as_literal = c.num_bytes * local_rate(a)
            if out and isinstance(out[-1], cmds.Literal):
                as_literal -= 4.0             # merged length header
            if c.num_bytes <= 32 and as_literal < cmd_cost[i]:
                data = raw[pos:pos + c.num_bytes]
                if out and isinstance(out[-1], cmds.Literal):
                    out[-1] = cmds.Literal(out[-1].data + data)
                else:
                    out.append(cmds.Literal(data))
            else:
                out.append(c)
            pos += c.num_bytes
        elif isinstance(c, cmds.Literal):
            if out and isinstance(out[-1], cmds.Literal):
                out[-1] = cmds.Literal(out[-1].data + c.data)
            else:
                out.append(c)
            pos += len(c.data)
        else:
            if isinstance(c, cmds.Dict):
                pos += c.final_size
            out.append(c)
    return out


def optimize(raw: bytes, commands: list[cmds.Command]) -> list[cmds.Command]:
    """Demote copies that cost more than literal-coding their bytes,
    then re-merge adjacent literals."""
    lit_bits = order1_bits_per_byte(raw) * 0.92   # context model beats order-1
    out: list[cmds.Command] = []
    pos = 0
    lru = [4, 11, 15, 16]
    for c in commands:
        if isinstance(c, cmds.Copy):
            copy_bits = _copy_cost_bits(c.num_bytes, c.distance, lru)
            as_literal = c.num_bytes * lit_bits
            # merging with an adjacent literal saves a length header (~4 bits)
            if out and isinstance(out[-1], cmds.Literal):
                as_literal -= 4.0
            if as_literal < copy_bits:
                data = raw[pos:pos + c.num_bytes]
                if out and isinstance(out[-1], cmds.Literal):
                    out[-1] = cmds.Literal(out[-1].data + data)
                else:
                    out.append(cmds.Literal(data))
            else:
                out.append(c)
                if c.distance != lru[0]:
                    lru = [c.distance] + lru[:3]
            pos += c.num_bytes
        elif isinstance(c, cmds.Literal):
            if out and isinstance(out[-1], cmds.Literal):
                out[-1] = cmds.Literal(out[-1].data + c.data)
            else:
                out.append(c)
            pos += len(c.data)
        else:
            if isinstance(c, cmds.Dict):
                pos += c.final_size
            out.append(c)
    return out
